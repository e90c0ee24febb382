"""RRAM fault engine, packed banks, crossbar read (kernel B2) and the
fused ApplyUpdate+Fail epilogue (kernel B1)."""
