"""Command-line entry points and meshes (port of ``repro.launch``): the
serving CLI, the training CLI on one device and the production meshes
(``launch/mesh.py``).  The training CLI's mesh arms and the multi-pod
dry-run wait for later slices (items 9h's training half, 9k and 9l)."""
