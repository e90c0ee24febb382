"""Reading and writing prototxts, binary protos and blobs (counterpart of
the reference package's utils/io.py): text-format nets and solvers,
binary `.caffemodel` weights and BlobProto files such as a mean file,
as the port's `proto.Message` objects and numpy arrays."""
from __future__ import annotations

import numpy as np

from .. import proto


def read_proto_text(path: str, type_name: str) -> proto.Message:
    with open(path, "r") as f:
        return proto.parse(f.read(), type_name)


def read_proto_binary(path: str, type_name: str) -> proto.Message:
    with open(path, "rb") as f:
        return proto.decode(f.read(), type_name)


def write_proto_binary(path: str, message: proto.Message) -> None:
    with open(path, "wb") as f:
        f.write(proto.encode(message))


BINARY_SUFFIXES = (".caffemodel", ".binaryproto", ".pb")


def upgrade_batchnorm(net: proto.Message) -> proto.Message:
    """The reference's BatchNorm upgrade (upgrade_net_batchnorm): old
    definitions declared three `param` specs for the layer's statistics,
    which the layer now owns; they are dropped, in place."""
    for lp in net.layer:
        if lp.type == "BatchNorm" and len(lp.param) == 3:
            lp.ClearField("param")
    return net


def read_net_param(path: str) -> proto.Message:
    """A NetParameter: binary for a `.caffemodel`/`.binaryproto`/`.pb`
    file, text otherwise, with the 3-param BatchNorm upgrade applied.
    Legacy V0/V1 nets (`layers`, field 2, instead of `layer`) need the
    reference package's other upgrade passes, which the port does not
    carry: text and binary ones raise."""
    if path.endswith((".h5", ".hdf5")):
        raise NotImplementedError(f"{path}: HDF5 weights are not read by "
                                  "the port")
    binary = path.endswith(BINARY_SUFFIXES)
    net = (read_proto_binary(path, "NetParameter") if binary
           else read_proto_text(path, "NetParameter"))
    if "layers" in net.set_fields():
        raise NotImplementedError(
            f"{path}: legacy V1 `layers` nets are not supported by the "
            "port; upgrade the " + ("model" if binary else "prototxt")
            + " to `layer` entries")
    return upgrade_batchnorm(net)


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


def array_to_blob(arr, blob: proto.Message = None) -> proto.Message:
    """An array as a BlobProto (shape and data; float64 as double_data),
    into `blob` when given."""
    if blob is None:
        blob = proto.Message("BlobProto")
    arr = np.asarray(arr)
    blob.shape.dim = [int(d) for d in arr.shape]
    blob.ClearField("data")
    blob.ClearField("double_data")
    if arr.dtype == np.float64:
        blob.double_data = arr.reshape(-1).tolist()
    else:
        blob.data = arr.astype(np.float32).reshape(-1).tolist()
    return blob


def read_blob_from_file(path: str) -> np.ndarray:
    """A binary BlobProto file (a mean file) as an array."""
    with open(path, "rb") as f:
        return blob_to_array(proto.decode_blob_proto(f.read()))
