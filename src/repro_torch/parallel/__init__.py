"""Distributed-optimization helpers: gradient compression with error
feedback (``collectives``). The mesh and ``hierarchical_psum`` wait for
ROADMAP Queue 1 item 4."""
