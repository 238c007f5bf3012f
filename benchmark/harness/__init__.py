"""What every cell shares: finding the cell's files, the seeded weights,
the loader wrapper, the traced window and the result line."""
