"""Host utilities of the port: stage timers and batch prefetching."""
