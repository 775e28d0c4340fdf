"""Command-line entry points and meshes (port of ``repro.launch``): the
serving CLI, the training CLI (one device, or the production meshes
through ``--mesh``) and the production meshes (``launch/mesh.py``).  The
multi-pod dry-run waits for a later slice (item 9l)."""
