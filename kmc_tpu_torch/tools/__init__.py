"""Host tools of the port over KMC databases (native/kmc_stream.cpp)."""
