"""One driver per entry into the program, found by the name a traffic mix gives."""
