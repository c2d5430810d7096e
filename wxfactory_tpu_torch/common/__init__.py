"""Constants shared by the whole port."""
