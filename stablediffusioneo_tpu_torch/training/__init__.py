"""Training-side modules of the port (counterpart of
stablediffusioneo_tpu/training/): so far the inference half of the LoRA
adapters (lora.py); the train steps wait for the training slice."""
