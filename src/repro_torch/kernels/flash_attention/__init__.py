"""Flash attention: the prefill / full-forward attention kernel."""
