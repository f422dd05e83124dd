"""Plain references that decide each run's ``correct``; they import nothing of the program."""
