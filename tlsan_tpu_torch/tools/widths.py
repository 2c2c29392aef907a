"""The shapes at which `chip_smoke.py`'s widths phase holds the attention
kernels' wide variants against their plain versions on the card, and at
which the CPU tests (`tests/test_torch_widths.py`) check their plans.

K1/K2 at heads of 33 to 1024 features, K3/K3b past 32-feature heads, past
D = 256 and past one CTA's shared memory: shapes (B, S, D, H) and (B, Tq,
Tk, D, H) of the grid every D with any H dividing it.  The train and
serving batches (32, 128), both towers' S (10, 25), S past one chunk of
steps, the ATRank blocks (96, 96) and (1, 96), (128, 128) and the readout
over 256 keys; D = 512 in one head (K3 and K3b in device memory) and in
512 heads of one feature; D = 1024 in 8 heads (K3b in device memory), D =
50 in 5 and 2 heads (rows read a float at a time), 300 keys (K3's scores
in a warp's slice) and FWA heads of 1024 features.
"""

WIDTHS_FWA = [(32, 10, 64, 1), (32, 25, 64, 1), (128, 10, 128, 1), (128, 25, 128, 2),
              (32, 25, 512, 1), (37, 40, 64, 1), (4, 301, 96, 2), (37, 33, 512, 1),
              (32, 10, 512, 512), (32, 10, 1024, 1)]
WIDTHS_MHA = [(32, 96, 96, 64, 1), (32, 1, 96, 64, 1), (128, 96, 96, 64, 1),
              (32, 128, 128, 128, 2), (32, 1, 256, 128, 2), (128, 96, 96, 256, 8),
              (32, 96, 96, 256, 8), (32, 96, 96, 512, 8), (32, 1, 96, 512, 8),
              (8, 128, 128, 512, 1), (32, 1, 256, 512, 1), (8, 128, 128, 512, 512),
              (9, 7, 250, 256, 4), (8, 96, 96, 1024, 8), (32, 96, 96, 50, 5),
              (8, 96, 96, 50, 2), (16, 1, 300, 64, 8), (4, 300, 300, 64, 8)]
