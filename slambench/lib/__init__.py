"""The benchmark's yardstick: the card's peaks and the kernels' roofline
arithmetic, the reduction of a profiler trace, the device record and the
trajectory error."""
