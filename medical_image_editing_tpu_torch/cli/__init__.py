"""Entry points: `edit_batch` (batched painted-map decode), `run_recon`
(model loading, single-slice edit), `serve_http`, `run_vqwnet` (the
trainers), `train_volumetric` / `edit_volume` (the volumetric VQ-WNet),
`export_model` (the edit decode as a `torch.export` program) and `doctor`
(environment diagnostics)."""
