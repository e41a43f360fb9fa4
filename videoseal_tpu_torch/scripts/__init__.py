"""Scripts: the 2D -> 2+1D inflation, a card from a training checkpoint
(make_config) and the SA-1B split and resize (process_sab)."""
