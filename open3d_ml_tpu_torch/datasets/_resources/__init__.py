"""Label tables and split lists of the datasets."""
