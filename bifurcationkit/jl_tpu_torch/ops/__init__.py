"""Hand-written kernels of the port and their plain versions (`sh_jv`)."""
