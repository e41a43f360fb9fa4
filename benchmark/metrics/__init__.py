"""Per-layer and end-to-end metrics, one reader a file: `read(run)` returns the value or None."""
