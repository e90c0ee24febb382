"""Reading prototxts and blobs (counterpart of the reference package's
utils/io.py): text-format nets and solvers, and BlobProto files such as
a mean file, into the port's `proto.Message` objects and numpy arrays."""
from __future__ import annotations

import numpy as np

from .. import proto


def read_proto_text(path: str, type_name: str) -> proto.Message:
    with open(path, "r") as f:
        return proto.parse(f.read(), type_name)


def read_net_param(path: str) -> proto.Message:
    """A text-format NetParameter. Legacy V0/V1 nets (`layers` instead
    of `layer`) need the reference package's upgrade pass, which the
    port does not carry; they raise."""
    net = read_proto_text(path, "NetParameter")
    if "layers" in net.set_fields():
        raise NotImplementedError(
            f"{path}: legacy V1 `layers` nets are not supported by the "
            "port; upgrade the prototxt to `layer` entries")
    return net


def read_solver_param(path: str) -> proto.Message:
    return read_proto_text(path, "SolverParameter")


def blob_shape(blob: proto.Message) -> tuple:
    if blob.HasField("shape"):
        return tuple(int(d) for d in blob.shape.dim)
    return (blob.num, blob.channels, blob.height, blob.width)


def blob_to_array(blob: proto.Message) -> np.ndarray:
    if blob.double_data:
        arr = np.asarray(blob.double_data, dtype=np.float64)
    else:
        arr = np.asarray(blob.data, dtype=np.float32)
    return arr.reshape(blob_shape(blob))


def read_blob_from_file(path: str) -> np.ndarray:
    """A binary BlobProto file (a mean file) as an array."""
    with open(path, "rb") as f:
        return blob_to_array(proto.decode_blob_proto(f.read()))
