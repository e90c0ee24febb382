"""Caffe's schema for the port: a text-format reader and writer and a
wire-format decoder and encoder over a trimmed copy of the schema, with
no protobuf dependency (the card's machine has none, and a second
registration of caffe.proto in protobuf's default pool would clash with
the reference package's)."""
from .message import Message
from .text_format import parse, to_text
from .wire import decode, decode_blob_proto, decode_datum, encode

# enum values the layers compare against (proto2 numbering)
TRAIN, TEST = 0, 1
POOL_MAX, POOL_AVE, POOL_STOCHASTIC = 0, 1, 2
NORM_FULL, NORM_VALID, NORM_BATCH_SIZE, NORM_NONE = 0, 1, 2, 3
FAN_IN, FAN_OUT, AVERAGE = 0, 1, 2
HDF5, BINARYPROTO = 0, 1          # SolverParameter.SnapshotFormat
ACROSS_CHANNELS, WITHIN_CHANNEL = 0, 1      # LRNParameter.NormRegion
ELTWISE_PROD, ELTWISE_SUM, ELTWISE_MAX = 0, 1, 2

__all__ = ["Message", "parse", "to_text", "decode", "decode_blob_proto",
           "decode_datum", "encode"]
