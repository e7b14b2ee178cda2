"""One reader a metric: ``<metric name>.py`` here defines ``read(run)``,
which returns the metric's value from a finished run (``slambench.run.Run``)
or None where the run holds nothing for it to read."""
