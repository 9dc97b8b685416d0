"""End-to-end examples of the port (counterparts of the repo's
``examples/``)."""
