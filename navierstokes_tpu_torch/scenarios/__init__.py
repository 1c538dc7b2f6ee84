"""Named scenarios and the command-line interface."""
