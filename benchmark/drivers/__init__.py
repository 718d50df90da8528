"""Drivers: one a kind of traffic, named by the traffic file's `driver`."""
