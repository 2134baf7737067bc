"""The benchmark's regression golden model: a frozen copy of the port's plain
PyTorch path (ORB extraction with the plain versions of kernels B1 and B2,
the tracker, mapping, BA, the loop verification and correction with its pose
graph, YOLOv8n) and of its synthetic renderer.  It imports nothing of the
port, so that a change to the port cannot change what the port is judged
against; being a copy, it cannot find a fault the port had from the start
(``benchlib.orb_independent`` holds B1 and B2 to code written apart).

Importing this package imports nothing heavy: ``slamref.io.synthetic`` needs
numpy alone, so frame-rendering workers start fast."""
