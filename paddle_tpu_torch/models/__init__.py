"""Model code of the port: LLaMA block math, paged decode, serving engine."""
