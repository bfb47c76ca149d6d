"""Command-line entry points of the port (``multibox-torch-*``).

Each ``main(argv)`` takes the flags of the JAX package's CLI of the same
name, plus ``--device`` (default: the CUDA device; ``cpu`` on request).
"""
