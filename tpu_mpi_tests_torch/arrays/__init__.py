"""Array layouts: ghost-cell domain decomposition (``domain.py``)."""
