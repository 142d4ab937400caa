"""The Cosmos image tokenizer (counterpart of uniception_tpu/models/libs/cosmos_tokenizer/): the 2D path."""
