"""The launch layer: production meshes, dry-run cells priced on the meta
device against an H100 roofline, the stencil dry run, and the ``train`` /
``serve`` entry points (twin of :mod:`repro.launch`).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh pod
    python -m repro_torch.launch.stencil_dryrun
    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced --device cpu
    python -m repro_torch.launch.serve --arch gemma2-9b --reduced --device cpu

Importing this package imports none of its modules.
"""
