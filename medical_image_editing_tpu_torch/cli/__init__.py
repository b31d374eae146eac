"""Entry points: `edit_batch` (batched painted-map decode) and `run_recon`
(model loading, single-slice edit)."""
