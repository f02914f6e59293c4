"""Checkpoint store of the port: crash-safe snapshots of maintained views
and train states."""
