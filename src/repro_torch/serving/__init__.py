"""Request and SLO bookkeeping shared by the engine and its drivers."""
