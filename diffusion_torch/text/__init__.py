"""Host-side text processing: the CLIP tokenizer."""
