"""Command-line entry points and meshes (port of ``repro.launch``): the
serving CLI, the training CLI (one device, or the production meshes
through ``--mesh``), the production meshes (``launch/mesh.py``) and the
multi-pod dry run on torch's fake process group (``launch/dryrun.py``)."""
