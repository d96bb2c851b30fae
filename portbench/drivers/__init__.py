"""How a traffic mix drives the program (`drivers/<name>.py`, named by
the traffic file's `driver` key): the warm-up and the measured window."""
