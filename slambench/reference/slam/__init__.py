"""A frozen copy of the SLAM tracking step and the bundle-adjustment solve.

Plain PyTorch, eager, on one device: the all-pairs Hamming matrix and
search-by-projection run as their plain torch forms (``ops/hamming.py``,
``ops/associate.py``), never as CUDA kernels, and nothing is captured as a
graph. It imports nothing of the program under test. ``slambench.reference``
runs it on the inputs that the benchmark made and on the program's state
before a sampled frame, and compares what comes out with what the program
produced.
"""
