"""Device half of the port: the sweep functions, their kernels and the
coverage engine. Importing this package loads nothing."""
