"""Species and deck file formats."""
