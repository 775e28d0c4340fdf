"""Command-line entry points (port of ``repro.launch``): the serving CLI.
Training, dry-run and the mesh launcher wait for later slices."""
