"""Serving (port of ``repro.serve``): the slot-batched server and its
virtual-time cost model."""
