"""One module per traffic kind: its set-up, measured window and checks."""
