"""NVIDIA H100 SXM 80GB constants (NVIDIA's data sheet, dense rates without
sparsity, at the card's full 700 W power limit): the peaks the dry-run's
roofline divides by.  A card set below 700 W runs slower under load, so a
share of these peaks is stated beside the card's power limit."""

PEAK_FLOPS_BF16 = 989e12        # H100 SXM: bf16 / fp16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12         # H100 SXM: float32 outside the tensor cores
HBM_BW = 3.35e12                # H100 SXM: HBM3 bytes/s
NVLINK_BW = 450e9               # H100 SXM: NVLink 4, 900 GB/s both ways, per direction
HBM_BYTES = 80 * 10**9          # H100 SXM 80GB: HBM3 bytes a card
CHIPS_SINGLE = 1                # the card mesh: one H100
CHIPS_SINGLE_POD = 256          # repro's single pod, (data 16, model 16), priced at the H100's peaks
CHIPS_MULTI_POD = 512           # two pods, (pod 2, data 16, model 16)
