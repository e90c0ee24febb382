#!/usr/bin/env python
"""Magnitude-prune the FC layers of a trained model and write the neuron
order file the remapping strategy reads (`prune_order_file`, run_gaussian_exp
-r): the reference's examples/gaussian_failure/prune_order.py, ported
whole. Same CLI, same bytes: one line of space-separated neuron indices
per pair of consecutive fault-target layers, the hidden layer's neurons
ascending by their zero-weight count (row zeros of the layer before plus
column zeros of the layer after) once each layer's smallest
`prune_ratio` share of weights is zeroed.

    python -m rram_caffe_simulation_tpu_torch.examples.gaussian_failure.prune_order \\
        net.prototxt model.caffemodel 0.6 order.txt [--cpu]

The layers are those of the net's TEST phase whose params are fault
targets (InnerProduct, whatever their names), with the model's weights
copied in by name (`Net.copy_trained_from`: a `.caffemodel` or a
`.caffemodel.h5`). Where the port differs, loudly: `--cpu` builds the net
on the CPU (default the card, raising without one).
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("proto")
    p.add_argument("model")
    p.add_argument("prune_ratio", type=float)
    p.add_argument("output_file")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    print(f"proto: {args.proto}; model: {args.model}; "
          f"prune_ratio: {args.prune_ratio}; "
          f"output_file: {args.output_file}")

    from ... import proto
    from ...core import prng
    from ...net import Net
    from ...utils.io import read_net_param

    net = Net(read_net_param(args.proto), proto.TEST,
              device="cpu" if args.cpu else None)
    params = net.copy_trained_from(net.init(prng.PRNGKey(0)), args.model)
    fc_weights = []
    for layer in net.layers:
        if layer.fault_target and params.get(layer.name):
            weights = params[layer.name][0].detach().cpu().numpy().copy()
            flat = weights.flatten()
            rank = np.argsort(np.abs(flat))
            flat[rank[:int(rank.size * args.prune_ratio)]] = 0
            np.copyto(weights, flat.reshape(weights.shape))
            fc_weights.append(weights)

    with open(args.output_file, "w") as wf:
        for i in range(1, len(fc_weights)):
            zero_nums = ((fc_weights[i - 1] == 0).sum(axis=1) +
                         (fc_weights[i] == 0).sum(axis=0))
            indexes = np.argsort(zero_nums)
            wf.write(" ".join(str(x) for x in indexes))
            wf.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
