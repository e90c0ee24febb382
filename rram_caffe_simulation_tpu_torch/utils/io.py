"""Reading and writing prototxts, binary protos and blobs (counterpart of
the reference package's utils/io.py): text-format nets and solvers,
binary `.caffemodel` weights and BlobProto files such as a mean file,
as the port's `proto.Message` objects and numpy arrays; and the HDF5
snapshot formats (the reference's layout: a net as `/data/<layer>/<i>`,
net.cpp ToHDF5; a solver state as `iter`, `learned_net`, `current_step`
and `/history/<i>`, sgd_solver.cpp SnapshotSolverStateToHDF5), through
`h5py` imported only where a function needs it. Where `h5py` cannot be
imported those functions raise NotImplementedError naming it."""
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
    """A NetParameter: HDF5 weights for a `.h5`/`.hdf5` file (as
    `read_net_hdf5` reads them), binary for a
    `.caffemodel`/`.binaryproto`/`.pb` file, text otherwise, with the
    3-param BatchNorm upgrade applied. Legacy V0/V1 nets (`layers`, field
    2, instead of `layer`) need the reference package's other upgrade
    passes, which the port does not carry: text and binary ones raise."""
    if path.endswith((".h5", ".hdf5")):
        return read_net_hdf5(path)
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


# ---------------------------------------------------------------------------
# HDF5 snapshot formats (reference net.cpp:883-930 ToHDF5, :821-860
# CopyTrainedLayersFromHDF5; sgd_solver.cpp:283-356)

def require_h5py(what: str = "HDF5"):
    """The `h5py` module, or NotImplementedError naming it and `what`
    asked for it."""
    try:
        import h5py
    except ImportError as e:
        raise NotImplementedError(
            f"{what}: HDF5 files need the h5py package, which cannot be "
            "imported here; install h5py or use snapshot_format: "
            "BINARYPROTO") from e
    return h5py


def write_net_hdf5(net_param: proto.Message, path: str) -> None:
    """Each layer's blobs as datasets `/data/<layer>/<i>` (a layer
    without blobs an empty group)."""
    h5py = require_h5py(f"write_net_hdf5({path!r})")
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for lp in net_param.layer:
            g = data.create_group(lp.name)
            for i, b in enumerate(lp.blobs):
                g.create_dataset(str(i), data=blob_to_array(b))


def read_net_hdf5(path: str) -> proto.Message:
    """A NetParameter of the file's layers (in the file's order) with
    their blobs."""
    h5py = require_h5py(f"read_net_hdf5({path!r})")
    out = proto.Message("NetParameter")
    with h5py.File(path, "r") as f:
        for name in f["data"]:
            lp = proto.Message("LayerParameter")
            lp.name = name
            g = f["data"][name]
            lp.blobs = [array_to_blob(np.asarray(g[i]))
                        for i in sorted(g, key=int)]
            out.layer.append(lp)
    return out


def write_solver_state_hdf5(path: str, iteration: int, learned_net: str,
                            current_step: int, history) -> None:
    h5py = require_h5py(f"write_solver_state_hdf5({path!r})")
    with h5py.File(path, "w") as f:
        f.create_dataset("iter", data=np.int64(iteration))
        f.create_dataset("learned_net", data=np.bytes_(learned_net.encode()))
        f.create_dataset("current_step", data=np.int64(current_step))
        g = f.create_group("history")
        for i, arr in enumerate(history):
            g.create_dataset(str(i), data=np.asarray(arr))


def read_solver_state_hdf5(path: str):
    """(iter, learned_net, current_step, [history arrays])."""
    h5py = require_h5py(f"read_solver_state_hdf5({path!r})")
    with h5py.File(path, "r") as f:
        it = int(np.asarray(f["iter"]))
        learned = np.asarray(f["learned_net"]).item()
        if isinstance(learned, bytes):
            learned = learned.decode()
        cur = int(np.asarray(f["current_step"]))
        g = f["history"]
        hist = [np.asarray(g[i]) for i in sorted(g, key=int)]
    return it, learned, cur, hist
