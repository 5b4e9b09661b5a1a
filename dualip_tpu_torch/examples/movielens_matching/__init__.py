"""MovieLens ratings as a matching LP, and the MovieLens-shaped proxy validation."""
