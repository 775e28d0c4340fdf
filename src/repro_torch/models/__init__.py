"""Dense decoder model and paged decode (port of ``repro.models``)."""
