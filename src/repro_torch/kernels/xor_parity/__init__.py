"""XOR parity kernel family: group parity encode and single-loss rebuild."""
