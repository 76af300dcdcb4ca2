"""Operations of the llama-class decoder's work (`configs/*.json` in the
Hugging Face keys), real tokens only: no bucket padding, no idle slot, no
step past a request's end."""

from __future__ import annotations


class Flops:
    def __init__(self, c: dict):
        E, H, Hkv = c["hidden_size"], c["num_attention_heads"], \
            c["num_key_value_heads"]
        D, F, self.L = E // H, c["intermediate_size"], c["num_hidden_layers"]
        self.linear = self.L * 2 * (E * H * D + 2 * E * Hkv * D + H * D * E
                                    + 3 * E * F)
        self.attn = self.L * 4 * H * D     # a (query, key) pair
        self.head = 2 * E * c["vocab_size"]

    def decode_token(self, context: int) -> float:
        """One decoded token attending `context` positions."""
        return self.linear + self.attn * context + self.head

    def prompt(self, P: int) -> float:
        """A P-token prompt scored in one pass, the head on its last row."""
        return P * self.linear + self.attn * P * (P + 1) // 2 + self.head
