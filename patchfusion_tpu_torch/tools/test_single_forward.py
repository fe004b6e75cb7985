"""The reference's single-forward example (its tools/test_single_forward.py)
as an alias of the port's infer CLI, with its arguments:

    python -m patchfusion_tpu_torch.tools.test_single_forward IMAGE \
        [--ckp-path CKP] [--cai-mode r128] [--out depth.png]
"""

from patchfusion_tpu_torch.tools.infer import main, parse_args  # noqa: F401

if __name__ == "__main__":
    from patchfusion_tpu_torch.parallel.dist import shutdown

    main()
    shutdown()
