"""Row sharding of the bsr operator over several devices (one process)."""
