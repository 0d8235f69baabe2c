"""Fused Lanczos step kernel family: the graphene stencil and the
three-term update in three passes."""
