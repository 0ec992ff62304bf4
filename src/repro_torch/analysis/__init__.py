"""Analysis helpers of the port: ``metering`` marks the sanctioned host
syncs (one-time calibrations) and counts their calls."""
