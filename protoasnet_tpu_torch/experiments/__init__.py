"""The port's experiment entry points. Two hold a hand-written kernel
against its plain PyTorch version and time kernel, library counterpart and
bound on the card, at the flagship's shapes (batch 8); three measure the
served flagship, the counterparts of the root ``experiments/`` tools.

    python -m protoasnet_tpu_torch.experiments.temporal_conv [--bf16]
        [--shape stem|layer1|layer2|layer3]
    python -m protoasnet_tpu_torch.experiments.fused_c2p1d [--fp32]
        [--block layer1|layer2|layer3]
    python -m protoasnet_tpu_torch.experiments.serving_latency [--quick]
    python -m protoasnet_tpu_torch.experiments.daemon_load [--null]
    python -m protoasnet_tpu_torch.experiments.int8_accuracy --run_dir R

Each takes ``--device cpu`` (a small size, or the plain version only; the
daemon's ``--null`` uses no device) and otherwise raises without a card.
``main(argv)`` returns the numbers, which ``chip_smoke.py`` reads.
"""
