"""Communication layer at world=1: topology (``mesh.py``), halo exchange
and the hot-loop runners (``halo.py``), collectives (``collectives.py``),
ring and all-to-all attention (``ring.py``, ``alltoall.py``).
"""
