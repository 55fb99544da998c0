"""The port's measurement scripts, run as modules on the card:

    python -m radix_sorting_tpu_torch.scripts.exp_sol_probe [--canary]
    python -m radix_sorting_tpu_torch.scripts.exp_sol_round2 [--only EXP]
    python -m radix_sorting_tpu_torch.scripts.profile_headline [n]

Each is the counterpart of the script of the same name under the
repository's ``scripts/``; E1 and E2, the kernels of the first two, are in
``csrc/sol.cu``.
"""
