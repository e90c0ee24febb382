"""The subset of the Caffe schema the port reads, as proto2 text.

Field numbers, types and defaults are those of the reference schema
(src/caffe/proto/caffe.proto and the fork's RRAM messages), trimmed to
the messages this package's layers, solver and data path read. A field
absent here still parses from a prototxt (kept raw, without a default);
a message absent here parses schema-less. `parse_schema` turns the text
into the tables `text_format` and `wire` consult.
"""
from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional

import numpy as np

SCHEMA_TEXT = """
message BlobShape {
  repeated int64 dim = 1 [packed = true];
}
message BlobProto {
  optional BlobShape shape = 7;
  repeated float data = 5 [packed = true];
  repeated float diff = 6 [packed = true];
  repeated double double_data = 8 [packed = true];
  repeated double double_diff = 9 [packed = true];
  optional int32 num = 1 [default = 0];
  optional int32 channels = 2 [default = 0];
  optional int32 height = 3 [default = 0];
  optional int32 width = 4 [default = 0];
}
message Datum {
  optional int32 channels = 1;
  optional int32 height = 2;
  optional int32 width = 3;
  optional bytes data = 4;
  optional int32 label = 5;
  repeated float float_data = 6;
  optional bool encoded = 7 [default = false];
}
message FillerParameter {
  optional string type = 1 [default = 'constant'];
  optional float value = 2 [default = 0];
  optional float min = 3 [default = 0];
  optional float max = 4 [default = 1];
  optional float mean = 5 [default = 0];
  optional float std = 6 [default = 1];
  optional int32 sparse = 7 [default = -1];
  enum VarianceNorm { FAN_IN = 0; FAN_OUT = 1; AVERAGE = 2; }
  optional VarianceNorm variance_norm = 8 [default = FAN_IN];
}
message NetParameter {
  optional string name = 1;
  repeated string input = 3;
  repeated int32 input_dim = 4;
  optional bool force_backward = 5 [default = false];
  optional NetState state = 6;
  optional bool debug_info = 7 [default = false];
  repeated LayerParameter layer = 100;
  repeated bytes layers = 2;
}
message FailurePatternParameter {
  optional string type = 1 [default = 'gaussian'];
  optional float mean = 2 [default = 10000];
  optional float std = 3 [default = 100];
  optional float min = 4 [default = 1000];
  optional float max = 5 [default = 100000];
  optional FailureProbParameter failure_prob = 6;
  optional bool conv_also = 7 [default = false];
}
message FailureProbParameter {
  optional int32 neg = 1 [default = 10];
  optional int32 zero = 2 [default = 20];
  optional int32 pos = 3 [default = 10];
}
message FailureStrategyParameter {
  required string type = 1;
  optional float threshold = 2 [default = 0.001];
  optional int32 start = 3 [default = 0];
  optional int32 period = 4 [default = 100];
  optional string prune_order_file = 5;
  optional int32 switch_time = 6 [default = 100];
  optional string prune_net_file = 7;
  optional string prune_model_file = 8;
  optional bool track_identity = 9 [default = false];
}
enum Phase { TRAIN = 0; TEST = 1; }
message NetState {
  optional Phase phase = 1 [default = TEST];
  optional int32 level = 2 [default = 0];
  repeated string stage = 3;
}
message NetStateRule {
  optional Phase phase = 1;
  optional int32 min_level = 2;
  optional int32 max_level = 3;
  repeated string stage = 4;
  repeated string not_stage = 5;
}
message ParamSpec {
  optional string name = 1;
  optional float lr_mult = 3 [default = 1.0];
  optional float decay_mult = 4 [default = 1.0];
}
message SolverState {
  optional int32 iter = 1;
  optional string learned_net = 2;
  repeated BlobProto history = 3;
  optional int32 current_step = 4 [default = 0];
}
message SolverParameter {
  optional string net = 24;
  optional NetParameter net_param = 25;
  optional string train_net = 1;
  optional NetParameter train_net_param = 21;
  optional NetState train_state = 26;
  repeated string test_net = 2;
  repeated NetParameter test_net_param = 22;
  repeated NetState test_state = 27;
  repeated int32 test_iter = 3;
  optional int32 test_interval = 4 [default = 0];
  optional bool test_compute_loss = 19 [default = false];
  optional bool test_initialization = 32 [default = true];
  optional float base_lr = 5;
  optional int32 display = 6;
  optional int32 average_loss = 33 [default = 1];
  optional int32 max_iter = 7;
  optional int32 iter_size = 36 [default = 1];
  optional string lr_policy = 8;
  optional float gamma = 9;
  optional float power = 10;
  optional float momentum = 11;
  optional float weight_decay = 12;
  optional string regularization_type = 29 [default = "L2"];
  optional int32 stepsize = 13;
  repeated int32 stepvalue = 34;
  optional float clip_gradients = 35 [default = -1];
  optional int32 snapshot = 14 [default = 0];
  optional string snapshot_prefix = 15;
  optional bool snapshot_diff = 16 [default = false];
  enum SnapshotFormat { HDF5 = 0; BINARYPROTO = 1; }
  optional SnapshotFormat snapshot_format = 37 [default = BINARYPROTO];
  optional int32 device_id = 18 [default = 0];
  optional int64 random_seed = 20 [default = -1];
  optional string type = 40 [default = "SGD"];
  enum SolverType { SGD = 0; NESTEROV = 1; ADAGRAD = 2; RMSPROP = 3; ADADELTA = 4; ADAM = 5; }
  optional SolverType solver_type = 30 [default = SGD];
  optional float delta = 31 [default = 1e-8];
  optional float momentum2 = 39 [default = 0.999];
  optional float rms_decay = 38 [default = 0.99];
  optional bool debug_info = 23 [default = false];
  optional bool snapshot_after_train = 28 [default = true];
  optional FailurePatternParameter failure_pattern = 41;
  repeated FailureStrategyParameter failure_strategy = 42;
  optional RRAMForwardParameter rram_forward = 43;
}
message RRAMForwardParameter {
  optional float sigma = 1 [default = 0];
  optional int32 adc_bits = 2 [default = 0];
  optional string tiles = 3 [default = ""];
}
message LayerParameter {
  optional string name = 1;
  optional string type = 2;
  repeated string bottom = 3;
  repeated string top = 4;
  optional Phase phase = 10;
  repeated float loss_weight = 5;
  repeated ParamSpec param = 6;
  repeated BlobProto blobs = 7;
  repeated NetStateRule include = 8;
  repeated NetStateRule exclude = 9;
  optional TransformationParameter transform_param = 100;
  optional LossParameter loss_param = 101;
  optional AccuracyParameter accuracy_param = 102;
  optional ConvolutionParameter convolution_param = 106;
  optional DataParameter data_param = 107;
  optional BatchNormParameter batch_norm_param = 139;
  optional BiasParameter bias_param = 141;
  optional InnerProductParameter inner_product_param = 117;
  optional InputParameter input_param = 143;
  optional PoolingParameter pooling_param = 121;
  optional ReLUParameter relu_param = 123;
  optional ScaleParameter scale_param = 142;
  optional SoftmaxParameter softmax_param = 125;
  optional ConcatParameter concat_param = 104;
  optional ContrastiveLossParameter contrastive_loss_param = 105;
  optional EltwiseParameter eltwise_param = 110;
  optional FlattenParameter flatten_param = 135;
  optional LRNParameter lrn_param = 118;
  optional ReshapeParameter reshape_param = 133;
  optional SigmoidParameter sigmoid_param = 124;
  optional SliceParameter slice_param = 126;
  optional TanHParameter tanh_param = 127;
  optional DropoutParameter dropout_param = 108;
  optional DummyDataParameter dummy_data_param = 109;
  optional HDF5DataParameter hdf5_data_param = 112;
  optional HDF5OutputParameter hdf5_output_param = 113;
  optional ImageDataParameter image_data_param = 115;
  optional MemoryDataParameter memory_data_param = 119;
  optional WindowDataParameter window_data_param = 129;
  optional PythonParameter python_param = 130;
}
message HDF5DataParameter {
  optional string source = 1;
  optional uint32 batch_size = 2;
  optional bool shuffle = 3 [default = false];
}
message HDF5OutputParameter {
  optional string file_name = 1;
}
message ImageDataParameter {
  optional string source = 1;
  optional uint32 batch_size = 4 [default = 1];
  optional uint32 rand_skip = 7 [default = 0];
  optional bool shuffle = 8 [default = false];
  optional uint32 new_height = 9 [default = 0];
  optional uint32 new_width = 10 [default = 0];
  optional bool is_color = 11 [default = true];
  optional float scale = 2 [default = 1];
  optional string mean_file = 3;
  optional uint32 crop_size = 5 [default = 0];
  optional bool mirror = 6 [default = false];
  optional string root_folder = 12 [default = ''];
}
message MemoryDataParameter {
  optional uint32 batch_size = 1;
  optional uint32 channels = 2;
  optional uint32 height = 3;
  optional uint32 width = 4;
}
message WindowDataParameter {
  optional string source = 1;
  optional float scale = 2 [default = 1];
  optional string mean_file = 3;
  optional uint32 batch_size = 4;
  optional uint32 crop_size = 5 [default = 0];
  optional bool mirror = 6 [default = false];
  optional float fg_threshold = 7 [default = 0.5];
  optional float bg_threshold = 8 [default = 0.5];
  optional float fg_fraction = 9 [default = 0.25];
  optional uint32 context_pad = 10 [default = 0];
  optional string crop_mode = 11 [default = 'warp'];
  optional bool cache_images = 12 [default = false];
  optional string root_folder = 13 [default = ''];
}
message PythonParameter {
  optional string module = 1;
  optional string layer = 2;
  optional string param_str = 3 [default = ''];
  optional bool share_in_parallel = 4 [default = false];
}
message DropoutParameter {
  optional float dropout_ratio = 1 [default = 0.5];
}
message DummyDataParameter {
  repeated FillerParameter data_filler = 1;
  repeated BlobShape shape = 6;
  repeated uint32 num = 2;
  repeated uint32 channels = 3;
  repeated uint32 height = 4;
  repeated uint32 width = 5;
}
message TransformationParameter {
  optional float scale = 1 [default = 1];
  optional bool mirror = 2 [default = false];
  optional uint32 crop_size = 3 [default = 0];
  optional string mean_file = 4;
  repeated float mean_value = 5;
}
message LossParameter {
  optional int32 ignore_label = 1;
  enum NormalizationMode { FULL = 0; VALID = 1; BATCH_SIZE = 2; NONE = 3; }
  optional NormalizationMode normalization = 3 [default = VALID];
  optional bool normalize = 2;
}
message AccuracyParameter {
  optional uint32 top_k = 1 [default = 1];
  optional int32 axis = 2 [default = 1];
  optional int32 ignore_label = 3;
}
message ConvolutionParameter {
  optional uint32 num_output = 1;
  optional bool bias_term = 2 [default = true];
  repeated uint32 pad = 3;
  repeated uint32 kernel_size = 4;
  repeated uint32 stride = 6;
  repeated uint32 dilation = 18;
  optional uint32 pad_h = 9 [default = 0];
  optional uint32 pad_w = 10 [default = 0];
  optional uint32 kernel_h = 11;
  optional uint32 kernel_w = 12;
  optional uint32 stride_h = 13;
  optional uint32 stride_w = 14;
  optional uint32 group = 5 [default = 1];
  optional FillerParameter weight_filler = 7;
  optional FillerParameter bias_filler = 8;
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 15 [default = DEFAULT];
  optional int32 axis = 16 [default = 1];
}
message DataParameter {
  enum DB { LEVELDB = 0; LMDB = 1; }
  optional string source = 1;
  optional uint32 batch_size = 4;
  optional uint32 rand_skip = 7 [default = 0];
  optional DB backend = 8 [default = LEVELDB];
  optional uint32 prefetch = 10 [default = 4];
}
message InnerProductParameter {
  optional uint32 num_output = 1;
  optional bool bias_term = 2 [default = true];
  optional FillerParameter weight_filler = 3;
  optional FillerParameter bias_filler = 4;
  optional int32 axis = 5 [default = 1];
  optional bool transpose = 6 [default = false];
}
message BatchNormParameter {
  optional bool use_global_stats = 1;
  optional float moving_average_fraction = 2 [default = .999];
  optional float eps = 3 [default = 1e-5];
}
message BiasParameter {
  optional int32 axis = 1 [default = 1];
  optional int32 num_axes = 2 [default = 1];
  optional FillerParameter filler = 3;
}
message ScaleParameter {
  optional int32 axis = 1 [default = 1];
  optional int32 num_axes = 2 [default = 1];
  optional FillerParameter filler = 3;
  optional bool bias_term = 4 [default = false];
  optional FillerParameter bias_filler = 5;
}
message InputParameter {
  repeated BlobShape shape = 1;
}
message PoolingParameter {
  enum PoolMethod { MAX = 0; AVE = 1; STOCHASTIC = 2; }
  optional PoolMethod pool = 1 [default = MAX];
  optional uint32 pad = 4 [default = 0];
  optional uint32 pad_h = 9 [default = 0];
  optional uint32 pad_w = 10 [default = 0];
  optional uint32 kernel_size = 2;
  optional uint32 kernel_h = 5;
  optional uint32 kernel_w = 6;
  optional uint32 stride = 3 [default = 1];
  optional uint32 stride_h = 7;
  optional uint32 stride_w = 8;
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 11 [default = DEFAULT];
  optional bool global_pooling = 12 [default = false];
}
message ReLUParameter {
  optional float negative_slope = 1 [default = 0];
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 2 [default = DEFAULT];
}
message SoftmaxParameter {
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 1 [default = DEFAULT];
  optional int32 axis = 2 [default = 1];
}
message LRNParameter {
  optional uint32 local_size = 1 [default = 5];
  optional float alpha = 2 [default = 1.];
  optional float beta = 3 [default = 0.75];
  enum NormRegion { ACROSS_CHANNELS = 0; WITHIN_CHANNEL = 1; }
  optional NormRegion norm_region = 4 [default = ACROSS_CHANNELS];
  optional float k = 5 [default = 1.];
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 6 [default = DEFAULT];
}
message EltwiseParameter {
  enum EltwiseOp { PROD = 0; SUM = 1; MAX = 2; }
  optional EltwiseOp operation = 1 [default = SUM];
  repeated float coeff = 2;
  optional bool stable_prod_grad = 3 [default = true];
}
message ConcatParameter {
  optional int32 axis = 2 [default = 1];
  optional uint32 concat_dim = 1 [default = 1];
}
message SliceParameter {
  optional int32 axis = 3 [default = 1];
  repeated uint32 slice_point = 2;
  optional uint32 slice_dim = 1 [default = 1];
}
message FlattenParameter {
  optional int32 axis = 1 [default = 1];
  optional int32 end_axis = 2 [default = -1];
}
message ReshapeParameter {
  optional BlobShape shape = 1;
  optional int32 axis = 2 [default = 0];
  optional int32 num_axes = 3 [default = -1];
}
message ContrastiveLossParameter {
  optional float margin = 1 [default = 1.0];
  optional bool legacy_version = 2 [default = false];
}
message SigmoidParameter {
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 1 [default = DEFAULT];
}
message TanHParameter {
  enum Engine { DEFAULT = 0; CAFFE = 1; CUDNN = 2; }
  optional Engine engine = 1 [default = DEFAULT];
}
"""

SCALAR_KINDS = ("double", "float", "int32", "int64", "uint32", "uint64",
                "bool", "string", "bytes")


class Field(NamedTuple):
    name: str
    number: int
    kind: str              # a SCALAR_KINDS entry, "enum" or "message"
    type_name: str         # enum or message name ("" for scalars)
    repeated: bool
    default: object        # None: the kind's zero value
    packed: bool = False   # a repeated number written as one run


class MessageType(NamedTuple):
    name: str
    fields: Dict[str, Field]
    by_number: Dict[int, Field]


_FIELD_RE = re.compile(
    r"(optional|repeated|required)\s+(\w+)\s+(\w+)\s*=\s*(\d+)"
    r"\s*(?:\[([^\]]*)\])?\s*;")
_DEFAULT_RE = re.compile(r"default\s*=\s*(\"[^\"]*\"|'[^']*'|[^,\s]+)")
_ENUM_RE = re.compile(r"enum\s+(\w+)\s*\{([^}]*)\}")
_MSG_RE = re.compile(r"message\s+(\w+)\s*\{")


def _enum_values(body: str) -> Dict[str, int]:
    out = {}
    for item in body.split(";"):
        item = item.strip()
        if item:
            k, v = item.split("=")
            out[k.strip()] = int(v)
    return out


def parse_schema(text: str):
    """(messages, enums): `messages` maps a message name to its
    MessageType; `enums` maps (scope, enum name) to {label: value},
    scope being the enclosing message or "" at file level."""
    enums: Dict[tuple, Dict[str, int]] = {}
    raw: Dict[str, list] = {}
    pos = 0
    while True:
        m_msg = _MSG_RE.search(text, pos)
        m_enum = _ENUM_RE.search(text, pos)
        if m_enum and (not m_msg or m_enum.start() < m_msg.start()):
            enums[("", m_enum.group(1))] = _enum_values(m_enum.group(2))
            pos = m_enum.end()
            continue
        if not m_msg:
            break
        name = m_msg.group(1)
        end = text.index("\n}", m_msg.end())
        body = text[m_msg.end():end]
        for e in _ENUM_RE.finditer(body):
            enums[(name, e.group(1))] = _enum_values(e.group(2))
        raw[name] = _FIELD_RE.findall(_ENUM_RE.sub("", body))
        pos = end + 2
    messages = {}
    for name, rows in raw.items():
        fields = {}
        for label, ftype, fname, num, options in rows:
            if ftype in SCALAR_KINDS:
                kind, tname = ftype, ""
            elif ftype in raw:
                kind, tname = "message", ftype
            else:
                kind, tname = "enum", ftype
            dval = None
            default = _DEFAULT_RE.search(options)
            if default:
                dval = _scalar_default(kind, default.group(1),
                                       _enum_table(enums, name, tname))
            fields[fname] = Field(fname, int(num), kind, tname,
                                  label == "repeated", dval,
                                  bool(re.search(r"packed\s*=\s*true",
                                                 options)))
        messages[name] = MessageType(
            name, fields, {f.number: f for f in fields.values()})
    return messages, enums


def _enum_table(enums, scope: str, tname: str) -> Optional[Dict[str, int]]:
    return enums.get((scope, tname)) or enums.get(("", tname))


def _scalar_default(kind: str, text: str, table):
    text = text.strip()
    if kind == "enum":
        return table[text]
    if kind in ("string", "bytes"):
        return text[1:-1]
    if kind == "bool":
        return text == "true"
    if kind == "float":
        return float(np.float32(text))   # as protobuf stores a float
    if kind == "double":
        return float(text)
    return int(text)


MESSAGES, ENUMS = parse_schema(SCHEMA_TEXT)


def enum_table(message: str, tname: str) -> Optional[Dict[str, int]]:
    return _enum_table(ENUMS, message, tname)
