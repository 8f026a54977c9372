"""The port's experiment entry points: each holds a hand-written kernel
against its plain PyTorch version and times kernel, library counterpart and
bound on the card, at the flagship's shapes (batch 8).

    python -m protoasnet_tpu_torch.experiments.temporal_conv [--bf16]
        [--shape stem|layer1|layer2|layer3]
    python -m protoasnet_tpu_torch.experiments.fused_c2p1d [--fp32]
        [--block layer1|layer2|layer3]

Both take ``--device cpu`` (plain version only, at a small size) and
otherwise raise without a card. ``main(argv)`` returns the numbers as a
dict, which ``chip_smoke.py`` reads.
"""
