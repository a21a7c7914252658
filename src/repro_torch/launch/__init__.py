"""Drivers of the port."""
