"""One driver a kind of configuration: set-up, window, check."""
