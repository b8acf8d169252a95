"""Query algorithms: indexed FORA levels, bounds and top-k refinement."""
