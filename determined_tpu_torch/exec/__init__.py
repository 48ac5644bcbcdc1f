"""Trial execution helpers of the port: the restart supervisor and the
checkpoint retention policy."""
