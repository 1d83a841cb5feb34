"""Dense transformer and Mamba2 SSM stacks (port of ``repro.models``)."""
