"""One module per architecture (exact public-literature configs)."""
