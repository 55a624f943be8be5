"""Train state and trainer of the port."""
