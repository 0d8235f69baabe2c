"""Per-row Fletcher checksum kernel family."""
