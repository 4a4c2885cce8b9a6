"""Slate storage: the device-resident open-addressing table."""
