"""Roofline terms of the port (``analyze``)."""
