"""Reed–Solomon erasure kernel family: GF(2^8) matrix products over
word-packed payloads (encode, syndrome, erasure solve)."""
