"""Fault-tolerance runtime."""
