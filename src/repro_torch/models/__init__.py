"""Dense transformer stack (port of ``repro.models``)."""
