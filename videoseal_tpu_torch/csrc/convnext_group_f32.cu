// K3 on f32 activations (design in convnext_group.cuh).

#include "convnext_group.cuh"

VS_ENTRY_GROUP(vs_cnx_group_f32, float)
