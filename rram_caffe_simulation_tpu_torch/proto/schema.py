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
  repeated int64 dim = 1;
}
message BlobProto {
  optional BlobShape shape = 7;
  repeated float data = 5;
  repeated float diff = 6;
  repeated double double_data = 8;
  repeated double double_diff = 9;
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
  optional string type = 1;
  optional float threshold = 2 [default = 0.001];
  optional int32 start = 3 [default = 0];
  optional int32 period = 4 [default = 100];
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
message SolverParameter {
  optional string net = 24;
  optional NetParameter net_param = 25;
  optional string train_net = 1;
  optional NetParameter train_net_param = 21;
  optional NetState train_state = 26;
  repeated int32 test_iter = 3;
  optional int32 test_interval = 4 [default = 0];
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
  optional int64 random_seed = 20 [default = -1];
  optional string type = 40 [default = "SGD"];
  optional float delta = 31 [default = 1e-8];
  optional float momentum2 = 39 [default = 0.999];
  optional float rms_decay = 38 [default = 0.99];
  optional bool debug_info = 23 [default = false];
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
  optional InnerProductParameter inner_product_param = 117;
  optional InputParameter input_param = 143;
  optional PoolingParameter pooling_param = 121;
  optional ReLUParameter relu_param = 123;
  optional SoftmaxParameter softmax_param = 125;
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


class MessageType(NamedTuple):
    name: str
    fields: Dict[str, Field]
    by_number: Dict[int, Field]


_FIELD_RE = re.compile(
    r"(optional|repeated|required)\s+(\w+)\s+(\w+)\s*=\s*(\d+)"
    r"\s*(?:\[\s*default\s*=\s*([^\]]+?)\s*\])?\s*;")
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
        for label, ftype, fname, num, default in rows:
            if ftype in SCALAR_KINDS:
                kind, tname = ftype, ""
            elif ftype in raw:
                kind, tname = "message", ftype
            else:
                kind, tname = "enum", ftype
            dval = None
            if default:
                dval = _scalar_default(kind, default,
                                       _enum_table(enums, name, tname))
            fields[fname] = Field(fname, int(num), kind, tname,
                                  label == "repeated", dval)
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
