"""Command-line entry points (port of ``repro.launch``): the serving CLI
and the training CLI on one device.  The multi-pod dry-run and the
production mesh launcher wait for later slices (items 9h, 9k, 9l)."""
