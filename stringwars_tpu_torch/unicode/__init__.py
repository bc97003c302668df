"""Unicode character data of the port (``tables``) and its generator (``gen_tables``)."""
