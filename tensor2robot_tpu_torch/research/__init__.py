"""Research models of the port."""
