"""Adam/AdamW with clipping and LR schedules (functional)."""
