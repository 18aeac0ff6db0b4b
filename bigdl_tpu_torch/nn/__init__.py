"""Layers and criteria of the port (counterpart: bigdl_tpu/nn/), in the
JAX package's export order."""

from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.nn.container import (Bottle, Concat, ConcatTable,
                                         Container, MapTable, ParallelTable,
                                         Sequential)
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.initialization import (ConstInitMethod,
                                               InitializationMethod,
                                               MsraFiller, Ones,
                                               RandomNormal, RandomUniform,
                                               Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import (Bilinear, CAdd, CMul, Cosine,
                                       Euclidean, Linear)
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                    SpatialDilatedConvolution,
                                    SpatialFullConvolution,
                                    SpatialShareConvolution,
                                    TemporalConvolution)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                       SpatialMaxPooling, TemporalMaxPooling)
from bigdl_tpu_torch.nn.volumetric import (VolumetricAveragePooling,
                                          VolumetricConvolution,
                                          VolumetricMaxPooling)
from bigdl_tpu_torch.nn.upsampling import (SpatialUpSamplingBilinear,
                                          SpatialUpSamplingNearest)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization, LayerNorm,
                                             Normalize, RMSNorm,
                                             SpatialBatchNormalization,
                                             SpatialCrossMapLRN, layer_norm)
from bigdl_tpu_torch.nn.activation import (Abs, Clamp, ELU, Exp, GELU,
                                           HardSigmoid, HardTanh, LeakyReLU,
                                           Log, LogSoftMax, Mish, Power,
                                           PReLU, ReLU, ReLU6, RReLU,
                                           Sigmoid, SoftMax, SoftPlus,
                                           SoftSign, Sqrt, Square, SReLU,
                                           Swish, Tanh)
from bigdl_tpu_torch.nn.dropout import (Dropout, GaussianDropout,
                                        GaussianNoise, SpatialDropout2D)
from bigdl_tpu_torch.nn.reshape import (AddConstant, Contiguous, Echo,
                                       GradientReversal, Identity, Masking,
                                       MulConstant, Narrow, Padding, Replicate,
                                       Reshape, Select, SpaceToDepth,
                                       SpatialZeroPadding, Squeeze, Transpose,
                                       Unsqueeze, View)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable, CosineDistance,
                                          CSubTable, DotProduct, FlattenTable,
                                          JoinTable, Max, Mean, Min, MM, MV,
                                          SelectTable, SplitTable, Sum)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.recurrent import (BiRecurrent, Cell,
                                          ConvLSTMPeephole, GRU, LSTM,
                                          LSTMPeephole, Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.nn.sparse import (LookupTableSparse, SparseJoinTable,
                                       SparseLinear, SparseTensor, addmm,
                                       addmv, encode_sparse)
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, ChunkedSoftmaxCE, ClassNLLCriterion,
    ClassSimplexCriterion, CosineEmbeddingCriterion, CosineProximityCriterion,
    CrossEntropyCriterion, DistKLDivCriterion, HingeEmbeddingCriterion,
    KLDCriterion, L1Cost, MarginCriterion, MarginRankingCriterion,
    MSECriterion, MultiCriterion, MultiLabelMarginCriterion,
    MultiMarginCriterion, ParallelCriterion, SmoothL1Criterion,
    TimeDistributedCriterion)
