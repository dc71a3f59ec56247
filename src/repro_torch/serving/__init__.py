"""FM-index query serving."""
