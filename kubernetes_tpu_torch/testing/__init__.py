"""Test fixtures of the port: the device-service fault script."""
