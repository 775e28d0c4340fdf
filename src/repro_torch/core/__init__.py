"""Plan compiler and step fusion (port of ``repro.core``)."""
