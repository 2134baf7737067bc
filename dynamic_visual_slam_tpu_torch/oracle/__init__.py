"""CPU f64 oracle implementations (scipy / OpenCV), the port's copies of
the reference package's ``oracle``: they validate the port's solvers and
pipeline against Ceres-grade numerics (``cli parity``, tests,
``chip_smoke.py``).  Never imported by the device path."""
