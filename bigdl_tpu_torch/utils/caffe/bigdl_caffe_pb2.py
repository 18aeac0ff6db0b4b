"""The schema of bigdl_caffe.proto, as tables for the port's protobuf
codec (utils/protowire.py).

Port of bigdl_tpu/utils/caffe/bigdl_caffe_pb2.py, which is protoc
output over `google.protobuf`; these tables are transcribed from its
serialized descriptor (bigdl_tpu/utils/caffe/bigdl_caffe_pb2.py:16) —
the minimal, wire-compatible subset of BVLC caffe.proto the converters
use (field numbers from upstream, so real .caffemodel and .prototxt
files parse; unknown fields are skipped). Every message, the enums
`Phase`, `V1LayerParameter.LayerType`, `PoolingParameter.PoolMethod`
and `.RoundMode`, `LRNParameter.NormRegion` and
`EltwiseParameter.EltwiseOp`, and the proto2 defaults
(tests/test_torch_protowire.py holds them against the descriptor).

    from bigdl_tpu_torch.utils.caffe import bigdl_caffe_pb2 as pb
    net = pb.NetParameter(); net.layer.add().type = "ReLU"
    pb.TEST, pb.PoolingParameter.MAX, pb.V1LayerParameter.CONVOLUTION
"""

from bigdl_tpu_torch.utils.protowire import REPEATED, Field as F, build

PACKAGE, SYNTAX = "bigdlcaffe", "proto2"

ENUMS = {
    "Phase": {"TRAIN": 0, "TEST": 1},
    "V1LayerParameter.LayerType": {
        "NONE": 0, "CONCAT": 3, "CONVOLUTION": 4, "DATA": 5, "DROPOUT": 6,
        "ELTWISE": 25, "FLATTEN": 8, "INNER_PRODUCT": 14, "LRN": 15,
        "POOLING": 17, "POWER": 26, "RELU": 18, "SIGMOID": 19, "SOFTMAX": 20,
        "SOFTMAX_LOSS": 21, "SPLIT": 22, "TANH": 23
    },
    "PoolingParameter.PoolMethod": {"MAX": 0, "AVE": 1, "STOCHASTIC": 2},
    "PoolingParameter.RoundMode": {"CEIL": 0, "FLOOR": 1},
    "LRNParameter.NormRegion": {"ACROSS_CHANNELS": 0, "WITHIN_CHANNEL": 1},
    "EltwiseParameter.EltwiseOp": {"PROD": 0, "SUM": 1, "MAX": 2},
}

MESSAGES = {
    "BlobShape": [
        F("dim", 1, "int64", REPEATED, packed=True),
    ],
    "BlobProto": [
        F("shape", 7, "message", type_name="BlobShape"),
        F("data", 5, "float", REPEATED, packed=True),
        F("diff", 6, "float", REPEATED, packed=True),
        F("num", 1, "int32", default=0),
        F("channels", 2, "int32", default=0),
        F("height", 3, "int32", default=0),
        F("width", 4, "int32", default=0),
    ],
    "FillerParameter": [
        F("type", 1, "string", default="constant"),
        F("value", 2, "float", default=0.0),
        F("std", 6, "float", default=1.0),
    ],
    "NetStateRule": [
        F("phase", 1, "enum", type_name="Phase"),
    ],
    "ParamSpec": [
        F("name", 1, "string"),
        F("lr_mult", 3, "float", default=1.0),
        F("decay_mult", 4, "float", default=1.0),
    ],
    "NetParameter": [
        F("name", 1, "string"),
        F("input", 3, "string", REPEATED),
        F("input_shape", 8, "message", REPEATED, type_name="BlobShape"),
        F("input_dim", 4, "int32", REPEATED),
        F("layer", 100, "message", REPEATED, type_name="LayerParameter"),
        F("layers", 2, "message", REPEATED, type_name="V1LayerParameter"),
    ],
    "LayerParameter": [
        F("name", 1, "string"),
        F("type", 2, "string"),
        F("bottom", 3, "string", REPEATED),
        F("top", 4, "string", REPEATED),
        F("phase", 10, "enum", type_name="Phase"),
        F("loss_weight", 5, "float", REPEATED),
        F("param", 6, "message", REPEATED, type_name="ParamSpec"),
        F("blobs", 7, "message", REPEATED, type_name="BlobProto"),
        F("include", 8, "message", REPEATED, type_name="NetStateRule"),
        F("exclude", 9, "message", REPEATED, type_name="NetStateRule"),
        F("batch_norm_param", 139, "message", type_name="BatchNormParameter"),
        F("concat_param", 104, "message", type_name="ConcatParameter"),
        F("convolution_param", 106, "message",
          type_name="ConvolutionParameter"),
        F("dropout_param", 108, "message", type_name="DropoutParameter"),
        F("eltwise_param", 110, "message", type_name="EltwiseParameter"),
        F("flatten_param", 135, "message", type_name="FlattenParameter"),
        F("inner_product_param", 117, "message",
          type_name="InnerProductParameter"),
        F("input_param", 143, "message", type_name="InputParameter"),
        F("lrn_param", 118, "message", type_name="LRNParameter"),
        F("pooling_param", 121, "message", type_name="PoolingParameter"),
        F("power_param", 122, "message", type_name="PowerParameter"),
        F("relu_param", 123, "message", type_name="ReLUParameter"),
        F("reshape_param", 133, "message", type_name="ReshapeParameter"),
        F("scale_param", 142, "message", type_name="ScaleParameter"),
        F("sigmoid_param", 124, "message", type_name="SigmoidParameter"),
        F("softmax_param", 125, "message", type_name="SoftmaxParameter"),
        F("tanh_param", 127, "message", type_name="TanHParameter"),
    ],
    "V1LayerParameter": [
        F("bottom", 2, "string", REPEATED),
        F("top", 3, "string", REPEATED),
        F("name", 4, "string"),
        F("type", 5, "enum", type_name="V1LayerParameter.LayerType"),
        F("blobs", 6, "message", REPEATED, type_name="BlobProto"),
        F("include", 32, "message", REPEATED, type_name="NetStateRule"),
        F("exclude", 33, "message", REPEATED, type_name="NetStateRule"),
        F("concat_param", 9, "message", type_name="ConcatParameter"),
        F("convolution_param", 10, "message",
          type_name="ConvolutionParameter"),
        F("dropout_param", 12, "message", type_name="DropoutParameter"),
        F("eltwise_param", 24, "message", type_name="EltwiseParameter"),
        F("inner_product_param", 17, "message",
          type_name="InnerProductParameter"),
        F("lrn_param", 18, "message", type_name="LRNParameter"),
        F("pooling_param", 19, "message", type_name="PoolingParameter"),
        F("power_param", 21, "message", type_name="PowerParameter"),
        F("relu_param", 30, "message", type_name="ReLUParameter"),
        F("sigmoid_param", 38, "message", type_name="SigmoidParameter"),
        F("softmax_param", 39, "message", type_name="SoftmaxParameter"),
        F("tanh_param", 37, "message", type_name="TanHParameter"),
    ],
    "InputParameter": [
        F("shape", 1, "message", REPEATED, type_name="BlobShape"),
    ],
    "ConvolutionParameter": [
        F("num_output", 1, "uint32"),
        F("bias_term", 2, "bool", default=True),
        F("pad", 3, "uint32", REPEATED),
        F("kernel_size", 4, "uint32", REPEATED),
        F("group", 5, "uint32", default=1),
        F("stride", 6, "uint32", REPEATED),
        F("weight_filler", 7, "message", type_name="FillerParameter"),
        F("bias_filler", 8, "message", type_name="FillerParameter"),
        F("pad_h", 9, "uint32", default=0),
        F("pad_w", 10, "uint32", default=0),
        F("kernel_h", 11, "uint32"),
        F("kernel_w", 12, "uint32"),
        F("stride_h", 13, "uint32"),
        F("stride_w", 14, "uint32"),
        F("dilation", 18, "uint32", REPEATED),
    ],
    "InnerProductParameter": [
        F("num_output", 1, "uint32"),
        F("bias_term", 2, "bool", default=True),
        F("weight_filler", 3, "message", type_name="FillerParameter"),
        F("bias_filler", 4, "message", type_name="FillerParameter"),
        F("axis", 5, "int32", default=1),
        F("transpose", 6, "bool", default=False),
    ],
    "PoolingParameter": [
        F("pool", 1, "enum", type_name="PoolingParameter.PoolMethod",
          default="MAX"),
        F("kernel_size", 2, "uint32"),
        F("stride", 3, "uint32", default=1),
        F("pad", 4, "uint32", default=0),
        F("kernel_h", 5, "uint32"),
        F("kernel_w", 6, "uint32"),
        F("stride_h", 7, "uint32"),
        F("stride_w", 8, "uint32"),
        F("pad_h", 9, "uint32", default=0),
        F("pad_w", 10, "uint32", default=0),
        F("global_pooling", 12, "bool", default=False),
        F("round_mode", 13, "enum", type_name="PoolingParameter.RoundMode",
          default="CEIL"),
    ],
    "LRNParameter": [
        F("local_size", 1, "uint32", default=5),
        F("alpha", 2, "float", default=1.0),
        F("beta", 3, "float", default=0.75),
        F("norm_region", 4, "enum", type_name="LRNParameter.NormRegion",
          default="ACROSS_CHANNELS"),
        F("k", 5, "float", default=1.0),
    ],
    "DropoutParameter": [
        F("dropout_ratio", 1, "float", default=0.5),
    ],
    "BatchNormParameter": [
        F("use_global_stats", 1, "bool"),
        F("moving_average_fraction", 2, "float", default=0.999),
        F("eps", 3, "float", default=1e-5),
    ],
    "ScaleParameter": [
        F("axis", 1, "int32", default=1),
        F("num_axes", 2, "int32", default=1),
        F("filler", 3, "message", type_name="FillerParameter"),
        F("bias_term", 4, "bool", default=False),
        F("bias_filler", 5, "message", type_name="FillerParameter"),
    ],
    "EltwiseParameter": [
        F("operation", 1, "enum", type_name="EltwiseParameter.EltwiseOp",
          default="SUM"),
        F("coeff", 2, "float", REPEATED),
    ],
    "ConcatParameter": [
        F("axis", 2, "int32", default=1),
        F("concat_dim", 1, "uint32", default=1),
    ],
    "PowerParameter": [
        F("power", 1, "float", default=1.0),
        F("scale", 2, "float", default=1.0),
        F("shift", 3, "float", default=0.0),
    ],
    "ReLUParameter": [
        F("negative_slope", 1, "float", default=0.0),
    ],
    "SigmoidParameter": [
    ],
    "TanHParameter": [
    ],
    "SoftmaxParameter": [
        F("axis", 2, "int32", default=1),
    ],
    "ReshapeParameter": [
        F("shape", 1, "message", type_name="BlobShape"),
        F("axis", 2, "int32", default=0),
        F("num_axes", 3, "int32", default=-1),
    ],
    "FlattenParameter": [
        F("axis", 1, "int32", default=1),
        F("end_axis", 2, "int32", default=-1),
    ],
}


globals().update(build(PACKAGE, SYNTAX, ENUMS, MESSAGES))
__all__ = [n for n in list(ENUMS) + list(MESSAGES) if "." not in n] + [
    v for n, e in ENUMS.items() if "." not in n for v in e]
