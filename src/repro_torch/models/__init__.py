"""The paper's models (``small``) and the LM serving path of the dense GQA
family (``common``, ``rotary``, ``params``, ``attention``, ``blocks``,
``transformer``)."""
