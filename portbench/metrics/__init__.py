"""One reader a metric (`metrics/<metric name>.py`), each with
`read(run)`: the metric's value, or None where it has nothing to read."""
