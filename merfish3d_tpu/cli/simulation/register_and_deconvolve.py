"""sim-preprocess: registration + deconvolution for simulation datastores
(mirrors `cli/statphysbio_simulation/register_and_deconvolve.py`)."""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sim-preprocess")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--decon", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--deformable-registration", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--ufish-model", type=str, default="simfish")
    p.add_argument("--decon-max-iters", type=int, default=40)
    p.add_argument(
        "--num-gpus", type=int, default=0,
        help="devices for tile fan-out (0 = all visible)",
    )
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from ...datastore import qi2labDataStore
    from ...pipeline.registration import DataRegistration

    ds = qi2labDataStore(args.datastore_path)
    reg = DataRegistration(
        ds,
        decon_fiducial=args.decon,
        decon_readout=args.decon,
        deformable_registration=args.deformable_registration,
        ufish_model=args.ufish_model,
        global_registration=True,
        decon_max_iters=args.decon_max_iters,
        num_devices=args.num_gpus,
    )
    reg.register_all_tiles()


if __name__ == "__main__":
    main()
