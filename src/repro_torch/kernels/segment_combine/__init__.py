"""Blocked segment combine: the Ch_msg / Ch_mir combine kernel."""
