"""Roofline accounting for the port (``roofline.py``): FLOPs per WAL
entry, the card's published ceilings, a measured matmul ceiling and the
MFU fields derived from one rate."""
