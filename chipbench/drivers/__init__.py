"""A driver per kind of traffic: set-up, the window, and the check."""
