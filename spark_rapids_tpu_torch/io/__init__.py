"""File scans: Parquet reading on the host and the device scan cache."""
