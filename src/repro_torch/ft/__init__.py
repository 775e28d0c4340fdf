"""Fault tolerance (port of ``repro.ft``): the straggler policy and the
serving step watchdog.  Checkpoints and elastic restarts wait for a later
slice."""
