"""Models of the port (counterpart: bigdl_tpu/models/):
`transformer` (the Transformer-LM), `rnn` (`simple_rnn`, `lstm_lm`,
`bilstm_sentiment`), `treelstm` (the binary TreeLSTM), `lenet`
(LeNet-5, also as a Graph), `resnet` (the CIFAR and ImageNet ResNets),
`inception` (v1 and v2), `vgg`, `alexnet`, `ncf` (NeuralCF),
`textclassifier`, `autoencoder`, `perf` (the synthetic-data
throughput harness) and `convert` (parameter trees across packages and
devices). Import them as submodules; this package imports none of
them, since `nn` itself uses `convert`."""
