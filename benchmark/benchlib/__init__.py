"""The benchmark's harness: cells resolved by name from ``BENCHMARK.json``
(``spec``), frames rendered from the seed (``frames``), the entry drivers
(``drivers``), spans and captures around the port's public functions
(``probes``), the device trace (``trace``), the comparison with the plain
reference that decides ``correct`` (``check``) and one run of a cell
(``cell``)."""
