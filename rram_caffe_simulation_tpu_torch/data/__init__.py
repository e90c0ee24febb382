"""Host-side data path: LMDB and LevelDB readers, Datum decode, image
codecs, the window crop, the transformer, the feeds."""
