"""Host-side data path: LMDB reader, Datum decode, transformer, feeds."""
