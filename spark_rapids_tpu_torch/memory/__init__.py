"""Device memory: the tiered buffer catalog, spillable batch handles, the
device manager and its semaphore, and the OOM retry."""
