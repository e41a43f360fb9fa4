"""Checkpoint scripts: the 2D -> 2+1D inflation."""
